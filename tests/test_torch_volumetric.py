"""The port's volumetric rendering (``transient_prbvolpath``: homogeneous
and grid media) against the JAX package on the CPU: the ``volumetric``
golden, ``render`` of each ``torch_cases.VOL_CASES`` configuration, one
wavefront per lane, the medium lookups (``density``, the shadow walk's
``transmittance``), the HG warp, the tracking streams, the media's scene
tables (inline, ``.vol`` and XML), and the variants' entry points (per
sample against the JAX package in tests/test_torch_variants_vol.py).

Both packages draw the same threefry streams, so the renders agree per
sample.  Tolerances: test_golden's rule (rtol 5e-4, atol 5e-5 * max) with
no element out, but for the golden, whose small box stands on the floor:
paths that leave the fog through its bottom meet the floor in the same
plane, and XLA:CPU's FMA-contracted hit distance and the port's
separately rounded one pick different triangles there
(``torch_cases.VOLUMETRIC_TIES`` bounds those elements; the same box 2 mm
up matches with none out, and so do the cases, whose box is lifted so).
Ray counts within 0.1 % (the JAX count is float32; the port's int64).
Lane values within 1e-5 relative and the medium lookups within 1e-6
(FMA); the threefry draws bit for bit.
"""
import copy
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu.core import rng as jrng
from mitransient_tpu.core import warp as jwarp
from mitransient_tpu.film import transient_film as jf
from mitransient_tpu.integrators import volpath as jvol
from mitransient_tpu.scene.schema import read_vol as j_read_vol
from mitransient_tpu.sensors import perspective as jpersp
from mitransient_tpu_torch.core import rng as trng
from mitransient_tpu_torch.core import warp as twarp
from mitransient_tpu_torch.core.spectrum import Variant
from mitransient_tpu_torch.film import transient_film as tf
from mitransient_tpu_torch.integrators import volpath as tvol
from mitransient_tpu_torch.scene import scene as tscene
from mitransient_tpu_torch.scene.schema import read_vol
from mitransient_tpu_torch.sensors import perspective as tpersp
from test_torch_scene import assert_leaves_equal
from torch_cases import (
    GRID_TO_WORLD,
    VOL_CASES,
    VOL_LIFT,
    VOLUMETRIC_TIE_RAYS,
    VOLUMETRIC_TIES,
    golden_mismatch,
    grid_density,
    hetero_medium,
    vol_case,
    vol_cbox,
)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "volumetric.npz")


def golden_desc(pkg, lift=0.0):
    """tests/golden_configs.py:volumetric's scene: 8 x 8, 120 bins, depth
    5, fog of sigma_t 2, albedo 0.9, HG g 0.1; rendered at spp 8, seed 0."""
    d = vol_cbox(pkg, 2.0, 0.9, 0.1, bins=120, lift=lift)
    d["sensor"]["film"].update(width=8, height=8)
    return d


def _render(pkg, desc, **kw):
    dev = {} if pkg is mitr else {"device": "cpu"}
    s, t, stats = pkg.render(pkg.load_dict(copy.deepcopy(desc), **dev),
                             return_stats=True, **kw)
    return np.asarray(s), np.asarray(t), float(stats["rays"]), stats["spp"]


@pytest.fixture(scope="module")
def jax_renders():
    """The JAX package's render of each case, made once."""
    cache = {}

    def get(name):
        if name not in cache:
            if name.startswith("golden"):
                lift = VOL_LIFT if name == "golden_lifted" else 0.0
                cache[name] = _render(mitr, golden_desc(mitr, lift), spp=8,
                                      seed=0)
            else:
                desc, kw = vol_case(mitr, name)
                cache[name] = _render(mitr, desc, **kw)
        return cache[name]

    return get


def test_volumetric_golden_within_its_ties(jax_renders):
    s, t, rays, _ = _render(mt, golden_desc(mt), spp=8, seed=0)
    golden = np.load(GOLDEN)
    for key, got in (("steady", s), ("transient", t)):
        m = golden_mismatch(got, golden[key])
        assert m["shape_ok"] and m["n_bad"] <= VOLUMETRIC_TIES[key], (key, m)
    jrays = jax_renders("golden")[2]
    assert abs(rays - jrays) <= VOLUMETRIC_TIE_RAYS * jrays and rays > 0


def test_volumetric_ties_are_the_box_bottom(jax_renders):
    """The golden's elements out come from the small box's bottom,
    coplanar with the floor: 2 mm up, none is out and the rays agree."""
    js, jt, jrays, _ = jax_renders("golden_lifted")
    s, t, rays, _ = _render(mt, golden_desc(mt, VOL_LIFT), spp=8, seed=0)
    for got, want in ((s, js), (t, jt)):
        m = golden_mismatch(got, want)
        assert m["shape_ok"] and m["n_bad"] == 0, m
    assert rays == jrays
    assert VOLUMETRIC_TIES["steady"] > 0


@pytest.mark.parametrize("name", VOL_CASES)
def test_render_matches_jax(jax_renders, name):
    desc, kw = vol_case(mitr, name)
    js, jt, jrays, jspp = jax_renders(name)
    s, t, rays, spp = _render(mt, desc, **kw)
    assert spp == jspp
    for got, want in ((s, js), (t, jt)):
        m = golden_mismatch(got, want)
        assert m["shape_ok"] and m["n_bad"] == 0, m
    assert abs(rays - jrays) <= 1e-3 * jrays and rays > 0
    assert float(np.abs(jt).sum()) > 0.0


def test_media_change_the_render(jax_renders):
    """The cases render what their media do: absorbing fog takes energy
    away from the null box's, scattering fog lengthens the transient."""
    clear = jax_renders("null_box")[0].sum()
    assert jax_renders("absorbing")[0].sum() < clear
    late = [jax_renders(n)[1].sum(axis=(0, 1, 3)) for n in ("null_box",
                                                           "fog")]
    centre = [float((np.arange(p.size) * p).sum() / p.sum()) for p in late]
    assert centre[1] > centre[0]


def test_phasor_film_matches_jax():
    """The fog into a phasor film (mono, as the film requires)."""
    out = []
    for pkg in (mitr, mt):
        pkg.set_variant("mono")
        try:
            desc, kw = vol_case(pkg, "phasor")
            out.append(_render(pkg, desc, **kw))
        finally:
            pkg.set_variant("rgb")
    (js, jp, jrays, _), (ts, tp, rays, _) = out
    assert tp.shape == jp.shape and tp.shape[-1] == 2
    for got, want in ((ts, js), (tp, jp)):
        m = golden_mismatch(got, want)
        assert m["shape_ok"] and m["n_bad"] == 0, m
    assert abs(rays - jrays) <= 1e-3 * jrays


def test_resume_is_bit_identical():
    """A volumetric render resumed from a pass's checkpoint is the
    uninterrupted render bit for bit."""
    desc, _kw = vol_case(mt, "fog")
    scene = mt.load_dict(desc, device="cpu")
    kw = dict(spp=6, seed=2, max_lanes=2 * 64)
    states = []
    s0, t0 = mt.render(scene, checkpoint_callback=states.append, **kw)
    assert [st[1] for st in states] == [1, 2, 3]
    s1, t1 = mt.render(scene, film_state=states[0], **kw)
    assert torch.equal(s1, s0) and torch.equal(t1, t0)


def _one_pass(name):
    """One pass of spp 3 of case ``name``'s scene through both
    packages' ``sample_volpath_primal``."""
    desc, _kw = vol_case(mitr, name)
    jsc, tsc = mitr.load_dict(copy.deepcopy(desc)), mt.load_dict(
        copy.deepcopy(desc), device="cpu")
    cfg = tsc.sensors[0].film
    spp, n = 3, 3 * 64
    jsamp = jrng.Sampler(jnp.uint32(5), n, stream=jnp.uint32(1))
    jray, jpix, jw = jpersp.sample_rays(jpersp.build_camera(jsc.sensors[0]),
                                        jsamp, 8, 8, spp)
    jout = jvol.sample_volpath_primal(
        jsc.data, jsamp, jray, jpix, jw, jf.film_init(jsc.sensors[0].film, 3),
        jsc.sensors[0].film, jsc.integrator, sample_scale=jnp.float32(1 / 3),
        base_dim=2, spp=spp)
    tsamp = trng.Sampler(5, n, 1)
    tray, tpix, tw = tpersp.sample_rays(tpersp.build_camera(tsc.sensors[0]),
                                        tsamp, 8, 8, spp)
    tout = tvol.sample_volpath_primal(
        tsc.data, tsamp, tray, tpix, tw, tf.film_init(cfg, 3), cfg,
        tsc.integrator, 1 / 3, spp)
    return jout, tout, cfg


@pytest.mark.parametrize("name", ["fog", "grid_random"])
def test_sample_volpath_primal_per_lane(name):
    """One pass: every lane's L, its valid flag, the film (overflow bin
    included) and the int64 ray count."""
    jout, tout, cfg = _one_pass(name)
    (jfilm, jL, jvalid, jrays), (tfilm, tL, tvalid, trays) = jout, tout
    jL = np.asarray(jL)
    np.testing.assert_allclose(tL.numpy(), jL, rtol=1e-5,
                               atol=1e-6 * np.abs(jL).max())
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    T = cfg.temporal_bins
    m = golden_mismatch(tfilm.transient.numpy(),
                        np.asarray(jfilm.transient)[:, :T + 1, :64])
    assert m["n_bad"] == 0, m
    assert trays.dtype == torch.int64
    jr = float(np.asarray(jrays))
    assert abs(int(trays) - jr) <= 1e-3 * jr and jr > 0


def test_queries_per_bounce(monkeypatch):
    """Each bounce queries closest hits 1 + TRANSMITTANCE_STEPS times (the
    path ray and the shadow walk), any-hit never, and splats once."""
    calls = {"closest": 0, "any": 0, "splat": 0}
    closest, any_hit = tscene._closest_hit_q, tscene._ray_test_q
    splat = tvol.splat_pair_any

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tscene, "_closest_hit_q", count("closest", closest))
    monkeypatch.setattr(tscene, "_ray_test_q", count("any", any_hit))
    monkeypatch.setattr(tvol, "splat_pair_any", count("splat", splat))
    desc, _kw = vol_case(mt, "fog")
    mt.render(mt.load_dict(desc, device="cpu"), spp=1, seed=0)
    depth = desc["integrator"]["max_depth"]
    assert calls == {"closest": depth * (1 + tvol.TRANSMITTANCE_STEPS),
                     "any": 0, "splat": depth}


def _grid_scenes():
    """A scene of three media: the seeded 8^3 grid with GRID_TO_WORLD in
    the small box, a 3 x 5 x 4 grid in the large box (edge-padded to 8^3)
    and homogeneous fog in a third box."""
    d = vol_cbox(mitr, 1.0, lift=VOL_LIFT)
    d["small-box"]["medium"] = hetero_medium(grid_density(), scale=2.5,
                                             to_world=GRID_TO_WORLD)
    d["large-box"]["bsdf"] = {"type": "null"}
    d["large-box"]["medium"] = hetero_medium(
        grid_density(4, 9)[:3, :, :].repeat(2, axis=1)[:, :5], scale=1.5)
    d["fog-box"] = {"type": "cube", "to_world": {
        "translate": [-0.5, 0.4, 0.3], "scale": 0.2},
        "bsdf": {"type": "null"},
        "medium": {"type": "homogeneous", "sigma_t": 0.7}}
    return (mitr.load_dict(copy.deepcopy(d)),
            mt.load_dict(copy.deepcopy(d), device="cpu"))


def test_medium_tables_equal_jax():
    jsc, tsc = _grid_scenes()
    assert_leaves_equal(jsc, tsc)
    assert tuple(tsc.data.medium.grid.shape) == (3, 8, 8, 8)
    assert tvol.has_grids(tsc.data)
    # the homogeneous golden scene: one row, a (1, 1, 1) grid
    jsc, tsc = (pkg.load_dict(golden_desc(pkg), **kw) for pkg, kw in (
        (mitr, {}), (mt, {"device": "cpu"})))
    assert_leaves_equal(jsc, tsc)
    assert not tvol.has_grids(tsc.data)


def test_density_matches_jax():
    """The trilinear lookup on random points in and around the grids of
    each medium (and vacuum lanes)."""
    jsc, tsc = _grid_scenes()
    rng = np.random.default_rng(2)
    n = 4096
    p = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    med = rng.integers(-1, 3, n).astype(np.int32)
    want = np.asarray(jvol._density(jsc.data, jnp.asarray(med),
                                    jnp.asarray(p)))
    got = tvol.density(tsc.data, torch.from_numpy(med), torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert np.ptp(want) > 0.5


@pytest.mark.parametrize("grids", [False, True])
def test_transmittance_matches_jax(grids):
    """Shadow rays from random points toward random points through the
    scene's null boxes: the walk's T and occlusion, homogeneous (analytic)
    and with grids (ratio tracking on its streams)."""
    if grids:
        jsc, tsc = _grid_scenes()
    else:
        jsc, tsc = (pkg.load_dict(golden_desc(pkg, VOL_LIFT), **kw)
                    for pkg, kw in ((mitr, {}), (mt, {"device": "cpu"})))
    rng = np.random.default_rng(4)
    n = 2048
    a = rng.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    b = rng.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    b[:, 1] = 0.98  # toward the ceiling, across the boxes
    vec = b - a
    dist = np.linalg.norm(vec, axis=-1).astype(np.float32)
    d = (vec / dist[:, None]).astype(np.float32)
    act = rng.random(n) < 0.9
    med = np.full(n, -1, np.int32)
    jT, jocc = jvol.transmittance(
        jsc.data, jnp.asarray(a), jnp.asarray(d), jnp.asarray(dist),
        jnp.asarray(med), jnp.asarray(act),
        key=jrng.Sampler(jnp.uint32(7), n, stream=jnp.uint32(0)).key, tag=3)
    tT, tocc = tvol.transmittance(
        tsc.data, *(torch.from_numpy(x) for x in (a, d, dist, med, act)),
        key=trng.Sampler(7, n, 0).key, tag=3)
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=1e-5,
                               atol=1e-6)
    crossed = (np.asarray(jT) < 1.0) & ~np.asarray(jocc)
    assert crossed.sum() > 20  # rays through the media that reach b


def test_tracking_draws_bit_equal(monkeypatch):
    """The grid tracking streams, drawn in lane slices, are
    ``jax.random.uniform`` of the whole shape bit for bit; so are rows of
    ``uniform`` drawn alone."""
    key = trng.Sampler(11, 1, 3).key
    jkey = jrng.Sampler(jnp.uint32(11), 1, stream=jnp.uint32(3)).key
    monkeypatch.setattr(tvol, "TRACKING_DRAW_LANES", 7)
    for tag, tail in ((2, (tvol.DELTA_STEPS, 2)),
                      (1000 + 4 * 2 + 3, (tvol.RATIO_STEPS,))):
        want = np.asarray(jax.random.uniform(
            jax.random.fold_in(jkey, jnp.uint32(jvol.GRID_STREAM_TAG) + tag),
            (37,) + tail))
        got = tvol.tracking_draw(key, tag, 37, tail)
        np.testing.assert_array_equal(got.numpy(), want)
    whole = trng.uniform(key, 0, (50, 6))
    np.testing.assert_array_equal(trng.uniform(key, 0, (50, 6),
                                               rows=(13, 29)).numpy(),
                                  whole[13:29].numpy())


def test_hg_warp_matches_jax():
    rng = np.random.default_rng(8)
    u = rng.random((4096, 2)).astype(np.float32)
    g = rng.uniform(-0.9, 0.9, 4096).astype(np.float32)
    g[:64] = rng.uniform(-5e-4, 5e-4, 64)  # the isotropic branch
    jd, jpdf = jwarp.square_to_hg(jnp.asarray(u), jnp.asarray(g))
    td, tpdf = twarp.square_to_hg(torch.from_numpy(u), torch.from_numpy(g))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=2e-6)
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-5)
    cos = rng.uniform(-1, 1, 4096).astype(np.float32)
    np.testing.assert_allclose(
        twarp.hg_pdf(torch.from_numpy(cos), torch.from_numpy(g)).numpy(),
        np.asarray(jwarp.hg_pdf(jnp.asarray(cos), jnp.asarray(g))),
        rtol=1e-5)


def _write_vol(path, grid):
    z, y, x = grid.shape
    with open(path, "wb") as f:
        f.write(b"VOL" + bytes([3]))
        f.write(struct.pack("<iiiii", 1, x, y, z, 1))
        f.write(struct.pack("<ffffff", 0, 0, 0, 1, 1, 1))
        f.write(grid.astype(np.float32).tobytes())


def test_read_vol_round_trip(tmp_path):
    """A Mitsuba .vol grid the test writes reads back as written, as the
    JAX reader reads it, and loads as a heterogeneous medium's density
    (relative to ``base_dir``) with the JAX loader's tables."""
    grid = np.random.default_rng(0).random((3, 4, 5)).astype(np.float32)
    _write_vol(str(tmp_path / "d.vol"), grid)
    back = read_vol(str(tmp_path / "d.vol"))
    np.testing.assert_array_equal(back, grid)
    np.testing.assert_array_equal(back, j_read_vol(str(tmp_path / "d.vol")))
    d = vol_cbox(mitr, 1.0)
    d["small-box"]["medium"] = {
        "type": "heterogeneous", "scale": 2.0,
        "density": {"type": "gridvolume", "filename": "d.vol",
                    "to_world": GRID_TO_WORLD}}
    jsc = mitr.load_dict(copy.deepcopy(d), base_dir=str(tmp_path))
    tsc = mt.load_dict(copy.deepcopy(d), device="cpu", base_dir=str(tmp_path))
    assert_leaves_equal(jsc, tsc)
    np.testing.assert_array_equal(tsc.data.medium.grid[0].numpy(), grid)


def test_load_file_of_a_medium(tmp_path):
    """A homogeneous medium inside a shape, from Mitsuba XML."""
    xml = """<scene version="3.0.0">
    <integrator type="transient_prbvolpath">
        <integer name="max_depth" value="6"/>
    </integrator>
    <sensor type="perspective">
        <transform name="to_world">
            <lookat origin="0, 0, 4" target="0, 0, 0" up="0, 1, 0"/>
        </transform>
        <film type="transient_hdr_film">
            <integer name="width" value="8"/>
            <integer name="height" value="8"/>
            <integer name="temporal_bins" value="50"/>
        </film>
    </sensor>
    <shape type="cube" id="fogbox">
        <bsdf type="null"/>
        <medium type="homogeneous" name="interior">
            <float name="sigma_t" value="1.5"/>
            <rgb name="albedo" value="0.8, 0.7, 0.6"/>
            <phase type="hg"><float name="g" value="0.4"/></phase>
        </medium>
    </shape>
    <shape type="rectangle" id="lamp">
        <transform name="to_world"><translate value="0, 0, -2"/></transform>
        <emitter type="area"><rgb name="radiance" value="1, 1, 1"/></emitter>
    </shape>
    </scene>"""
    path = str(tmp_path / "fog.xml")
    with open(path, "w") as f:
        f.write(xml)
    jsc, tsc = mitr.load_file(path), mt.load_file(path, device="cpu")
    assert_leaves_equal(jsc, tsc)
    assert tsc.integrator.kind == "transient_prbvolpath"
    for f in tsc.integrator._fields:
        assert getattr(tsc.integrator, f) == getattr(jsc.integrator, f), f
    np.testing.assert_allclose(tsc.data.medium.albedo.numpy(),
                               [[0.8, 0.7, 0.6]], rtol=1e-6)
    assert float(tsc.data.medium.g[0]) == pytest.approx(0.4)
    assert "fogbox.interior.albedo.value" in mt.traverse(tsc).keys()


@pytest.mark.parametrize("variant", ["polarized", "spectral"])
def test_unported_volumetric_variants_raise(variant):
    """A polarized or spectral volumetric scene, which the port once
    refused (ROADMAP item 16b), renders and differentiates in every entry
    point, as the JAX package does: finite results of the variant's film
    (12 Stokes channels for rgb_polarized); render_backward_volpath of the
    polarized scene raises the JAX package's message and render_backward
    sends it to full AD instead."""
    from mitransient_tpu_torch.render import render_backward_volpath

    scene = mt.load_dict(golden_desc(mt), device="cpu")
    scene.variant = Variant(3, **{variant: True})
    C = 12 if variant == "polarized" else 3
    adj = (None, np.ones((8, 8, 120, C), np.float32))
    s, t = mt.render(scene, spp=1)
    assert s.shape == (8, 8, C) and t.shape == (8, 8, 120, C)
    assert torch.isfinite(t).all() and float(s[..., :3].sum()) > 0
    grads = mt.render_backward(scene, adj, spp=1)
    assert torch.isfinite(grads["white.reflectance.value"]).all()
    assert float(grads["white.reflectance.value"].abs().sum()) > 0
    d_s, d_t = mt.render_forward(scene, {"white.reflectance.value":
                                         np.ones(3, np.float32)}, spp=1)
    assert d_t.shape == (8, 8, 120, C) and torch.isfinite(d_t).all()
    assert float(d_s.abs().sum()) > 0
    if variant == "polarized":
        with pytest.raises(NotImplementedError, match="primal-only"):
            render_backward_volpath(scene, adj, spp=1)
