"""The port's multi-device rendering (``mitransient_tpu_torch/parallel``)
on logical CPU shards, held per sample against the JAX package's sharded
calls on as many of its virtual CPU devices, with the same seed and spp.

Both packages draw shard ``g``'s samples of pass ``p`` from the threefry
stream ``p * n + g`` and add the shards' fresh film partials after each
pass, so they trace the same samples.  Tolerances:

* renders: test_golden's rule (rtol 5e-4, atol 5e-5 * max), no element
  out (float32 sums in another order; XLA:CPU's FMA); the volumetric
  box of tests/test_parallel.py, whose small box stands on the floor,
  within ``SHARDED_VOL_TIES`` by name (ROADMAP queue 3), and with the box
  2 mm off the floor (``torch_cases.VOL_LIFT``) with no element out;
* rays within 0.1 % (a lane whose decision flips at an FMA-rounded tie);
* gradient tables within 1e-4 of each table's largest |value|, the full-AD
  shape poses of the volumetric box within the named ``VOL_POSE_TIES``;
* the sharded exhaustive capture: its transient bit for bit the port's
  local capture, its steady image within rtol 1e-5 (another summation
  order);
* one shard against the single-device multi-pass ``render``: rtol 1e-5
  (fresh films a pass against one film, the JAX package's own bound,
  tests/test_parallel.py:189-192).
"""
import copy

import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu.parallel import mesh as jmesh
from mitransient_tpu_torch.parallel import mesh as tmesh
from mitransient_tpu_torch.parallel import dryrun_multichip
from torch_cases import (
    VOL_LIFT,
    golden_mismatch,
    nlos_scene,
    small_cbox,
    vol_cbox,
    with_variant,
)

torch.set_num_threads(1)

RAYS_RTOL = 1e-3
GRAD_ATOL = 1e-4  # of each table's largest |value|


def _cbox(pkg, w=16, h=16, bins=60, **film):
    d = small_cbox(pkg, w, h, bins, max_depth=8)
    d["sensor"]["film"].update(film)
    return d


def _load(desc, variant=None):
    """(JAX scene, port scene on the CPU) of ``desc``."""
    if variant is None:
        return (mitr.load_dict(copy.deepcopy(desc)),
                mt.load_dict(copy.deepcopy(desc), device="cpu"))
    with with_variant(mitr, variant), with_variant(mt, variant):
        return (mitr.load_dict(copy.deepcopy(desc)),
                mt.load_dict(copy.deepcopy(desc), device="cpu"))


def _shards(n):
    return tmesh.make_mesh(devices=["cpu"] * n)


def _render_both(desc, n, spp, seed=0, variant=None, focus=None):
    """The JAX package's and the port's sharded renders of ``desc`` over
    ``n`` shards -> ((steady, transient, stats) as numpy, twice)."""
    jsc, tsc = _load(desc, variant)
    if focus is not None:
        mitr.nlos.focus_emitter_at_relay_wall_pixel(focus, jsc)
        mt.nlos.focus_emitter_at_relay_wall_pixel(focus, tsc)
    js, jt, jst = jmesh.render_sharded(jsc, jmesh.make_mesh(n), spp=spp,
                                       seed=seed, return_stats=True)
    ts, tt, tst = tmesh.render_sharded(tsc, _shards(n), spp=spp, seed=seed,
                                       return_stats=True)
    return ((np.asarray(js), np.asarray(jt), jst),
            (ts.numpy(), tt.numpy(), tst))


def _assert_renders_match(port, ref, ties=None):
    ties = ties or {}
    for name, got, want in zip(("steady", "transient"), port, ref):
        m = golden_mismatch(got, want)
        assert m["shape_ok"] and m["n_bad"] <= ties.get(name, 0), (name, m)
    assert port[2]["devices"] == ref[2]["devices"]
    assert port[2]["spp"] == ref[2]["spp"]
    r_p, r_j = port[2]["rays"], float(ref[2]["rays"])
    assert isinstance(r_p, int)
    assert abs(r_p - r_j) <= RAYS_RTOL * r_j, (r_p, r_j)


def _assert_tables_match(gp, gj, ties=None):
    """Every gradient table within GRAD_ATOL of its largest |value|; the
    tables named in ``ties`` ({field: (elements, bound)}) with at most that
    many elements beyond GRAD_ATOL, none beyond the bound.  Where the JAX
    package's sharded PRB replay hands back the scene's shape-pose tables
    as zeros (it passes the geometry deltas the replay does not
    differentiate), the port has None, as both packages' single-device
    replays have."""
    ties = ties or {}
    tp, tj = gp["__tables__"], gj["__tables__"]
    zero = set()
    for f in tp._fields:
        g, w = getattr(tp, f), getattr(tj, f)
        if g is None and w is not None and not np.any(np.asarray(w)):
            zero.add(f)
            continue
        assert (g is None) == (w is None), f
        if g is None:
            continue
        g, w = g.numpy().astype(np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, f
        scale = max(float(np.abs(w).max()), 1e-30)
        n_out, bound = ties.get(f, (0, GRAD_ATOL))
        np.testing.assert_allclose(g, w, rtol=0, atol=bound * scale,
                                   err_msg=f)
        assert int((np.abs(g - w) > GRAD_ATOL * scale).sum()) <= n_out, f
    assert set(gp) <= set(gj)
    for k in set(gj) - set(gp):  # the zero pose tables' paths
        assert not np.any(np.asarray(gj[k])), k
    assert zero <= {"shape_translate", "shape_rotate"}, zero


@pytest.fixture(scope="module")
def cbox_renders():
    """The 16x16 box over 2 and 4 shards at spp 64."""
    return {n: _render_both(_cbox(mitr), n, spp=64) for n in (2, 4)}


def test_sharded_render_matches_jax(cbox_renders):
    ref, port = cbox_renders[4]
    _assert_renders_match(port, ref)
    s, t, stats = port
    assert stats["devices"] == 4 and stats["spp"] == 64
    assert s.shape == (16, 16, 3) and t.shape == (16, 16, 60, 3)
    assert 0.4 < t.sum() / s.sum() <= 1.0001


def test_device_count_changes_sample_set_not_mean(cbox_renders):
    """2 shards against 4: each held against the JAX package's, and the
    two sample sets' means within 15 %."""
    ref2, port2 = cbox_renders[2]
    _assert_renders_match(port2, ref2)
    m2, m4 = port2[0].mean(), cbox_renders[4][1][0].mean()
    assert not np.array_equal(port2[0], cbox_renders[4][1][0])
    assert abs(m2 - m4) / m2 < 0.15


def test_sharded_deterministic():
    """8 shards: two renders bit for bit, and per sample the JAX
    package's 8-device render."""
    desc = _cbox(mitr)
    ref, port = _render_both(desc, 8, spp=16, seed=3)
    _assert_renders_match(port, ref)
    sc = mt.load_dict(copy.deepcopy(desc), device="cpu")
    s2, t2 = tmesh.render_sharded(sc, _shards(8), spp=16, seed=3)
    assert np.array_equal(s2.numpy(), port[0])
    assert np.array_equal(t2.numpy(), port[1])


def test_one_shard_matches_multipass_render():
    """One shard, one pass a pass: the single-device multi-pass render's
    samples (several passes: the sum order differs)."""
    sc = mt.load_dict(_cbox(mt, 8, 8, 30), device="cpu")
    s1, t1, st1 = tmesh.render_sharded(sc, _shards(1), spp=12, seed=2,
                                       spp_per_pass_per_device=4,
                                       return_stats=True)
    s0, t0, st0 = mt.render(sc, spp=12, seed=2, max_lanes=4 * 64,
                            regenerate=False, return_stats=True)
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t1.numpy(), t0.numpy(), rtol=1e-5, atol=1e-7)
    assert st1["rays"] == int(st0["rays"])


@pytest.mark.parametrize("capture", ["single", "confocal"])
def test_sharded_nlos_matches_jax(capture):
    if capture == "single":
        desc, spp, focus = nlos_scene(sx=4, sy=4, bins=200), 128, None
    else:
        desc = nlos_scene(sx=1, sy=1, bins=200)
        desc["integrator"]["capture_type"] = "confocal"
        desc["relay_wall"]["nlos_sensor"].update(original_film_width=2,
                                                 original_film_height=2)
        spp, focus = 64, [1.0, 1.0]
    ref, port = _render_both(desc, 4, spp=spp, focus=focus)
    _assert_renders_match(port, ref)
    assert port[1].sum() > 0


# the volumetric box of tests/test_parallel.py (its small box on the floor):
# elements out of test_golden's rule between the packages' 4-shard renders
# (8 x 8, 60 bins, spp 32), from paths in the fog that leave the box
# through its bottom, coplanar with the floor, where XLA's FMA-contracted
# hit distance and the port's separately rounded one pick different
# triangles (ROADMAP queue 3); 5 rays of 33,480.  With the box 2 mm off the
# floor none is out.
SHARDED_VOL_TIES = {"steady": 19, "transient": 22}
# the full-AD shape-pose tables of the volumetric box 2 mm off the floor at
# seed 0: elements beyond 1e-4 of the table's largest |value| (4 of 24 in
# each, at most 2.3e-3 measured) and their bound, as VOL_POSE_TIES of
# tests/test_torch_variants_grad.py.  On the floor the coplanar tie moves
# full AD's tables further (medium sigma_t by 7 %, ROADMAP queue 3), so
# the gradient cases lift the box, as the port's other per-sample
# volumetric gradient tests do.
VOL_POSE_TIES = {"shape_translate": (4, 1e-2), "shape_rotate": (4, 1e-2)}


def _vol_desc(lift=VOL_LIFT, **kw):
    return vol_cbox(mitr, 2.0, lift=lift, **kw)


@pytest.mark.parametrize("lift", [0.0, VOL_LIFT], ids=["floor", "lifted"])
def test_sharded_volumetric_render(lift):
    desc = _vol_desc(lift, w=8, h=8, bins=60, max_depth=4)
    desc["sensor"]["film"].update(start_opl=0.0, bin_width_opl=0.3)
    ref, port = _render_both(desc, 4, spp=32)
    _assert_renders_match(port, ref, ties=SHARDED_VOL_TIES if lift == 0.0
                          else None)
    assert port[1].sum() > 0


def test_sharded_volumetric_albedo_grad():
    """Full AD of the volumetric box over 4 shards, the ``medium.albedo``
    path among the named gradients: per sample the JAX package's sharded
    backward, and statistically the single-device ``render_backward`` (the
    volumetric PRB replay, other samples) within 30 %."""
    desc = _vol_desc(w=8, h=8, bins=60, max_depth=4)
    desc["sensor"]["film"].update(start_opl=0.0, bin_width_opl=0.3)
    jsc, tsc = _load(desc)
    ones_t = np.ones((8, 8, 60, 3), np.float32)
    gj = jmesh.render_backward_sharded(jsc, jmesh.make_mesh(4),
                                       (None, ones_t), spp=16, seed=0)
    gp = tmesh.render_backward_sharded(tsc, _shards(4), (None, ones_t),
                                       spp=16, seed=0)
    _assert_tables_match(gp, gj, ties=VOL_POSE_TIES)
    key = next(k for k in gp if k.endswith("albedo.value"))
    a = gp[key].numpy()
    b = mt.render_backward(tsc, (None, ones_t), spp=16, seed=0)[key].numpy()
    assert np.linalg.norm(a) > 0
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 0.3


def test_sharded_polarized_matches_jax():
    desc = _cbox(mitr, 8, 8, 60)
    desc["integrator"]["max_depth"] = 3
    ref, port = _render_both(desc, 4, spp=16, variant="mono_polarized")
    _assert_renders_match(port, ref)
    assert port[0].shape == (8, 8, 4) and port[0][..., 0].sum() > 0


def test_sharded_gaussian_rfilter():
    """The gaussian rfilter: one shard equals the local multi-pass render
    (one pass: the same sums), four shards the JAX package's."""
    desc = _cbox(mitr, rfilter={"type": "gaussian", "stddev": 0.8})
    sc = mt.load_dict(copy.deepcopy(desc), device="cpu")
    s_loc, t_loc = mt.render(sc, spp=8, seed=0)
    s1, t1 = tmesh.render_sharded(sc, _shards(1), spp=8, seed=0)
    np.testing.assert_allclose(s1.numpy(), s_loc.numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(t1.numpy(), t_loc.numpy(), rtol=1e-5,
                               atol=1e-7)
    ref, port = _render_both(desc, 4, spp=32)
    _assert_renders_match(port, ref)


def test_sharded_crop_matches_jax():
    desc = _cbox(mitr, crop_width=8, crop_height=6, crop_offset_x=4,
                 crop_offset_y=5)
    ref, port = _render_both(desc, 4, spp=64)
    _assert_renders_match(port, ref)
    assert port[0].shape == (6, 8, 3) and port[1].shape == (6, 8, 60, 3)


def test_sharded_polarized_volumetric_backward():
    """Full AD of a polarized volumetric scene over 4 shards."""
    desc = _vol_desc(albedo=0.8, g=0.2, w=8, h=8, bins=50, max_depth=6)
    desc["sensor"]["film"].update(start_opl=0.0, bin_width_opl=1.2)
    jsc, tsc = _load(desc, "rgb_polarized")
    adj = np.zeros((8, 8, 50, 12), np.float32)
    adj[..., 0:3] = 1.0
    gj = jmesh.render_backward_sharded(jsc, jmesh.make_mesh(4), (None, adj),
                                       spp=16, seed=0)
    gp = tmesh.render_backward_sharded(tsc, _shards(4), (None, adj), spp=16,
                                       seed=0)
    _assert_tables_match(gp, gj, ties=VOL_POSE_TIES)
    key = next(k for k in gp if "albedo" in k)
    assert np.all(np.isfinite(gp[key].numpy())) and gp[key].abs().sum() > 0


def test_sharded_prb_backward_matches_jax():
    """The PRB replay over 4 shards: per sample the JAX package's sharded
    backward, and statistically the single-device one."""
    desc = _cbox(mitr, 8, 8, 60, start_opl=0.0, bin_width_opl=0.3)
    desc["integrator"].update(max_depth=3, rr_depth=99)
    jsc, tsc = _load(desc)
    ones_t = np.ones((8, 8, 60, 3), np.float32)
    gj = jmesh.render_backward_sharded(jsc, jmesh.make_mesh(4),
                                       (None, ones_t), spp=64, seed=0)
    gp = tmesh.render_backward_sharded(tsc, _shards(4), (None, ones_t),
                                       spp=64, seed=0)
    _assert_tables_match(gp, gj)
    g1 = mt.render_backward(tsc, (None, ones_t), spp=64, seed=0)
    a = gp["white.reflectance.value"].numpy()
    b = g1["white.reflectance.value"].numpy()
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 0.2


@pytest.mark.parametrize("variant", ["rgb", "mono_polarized"])
def test_sharded_exhaustive_matches_local(variant):
    """6 laser points over 4 shards (2 uneven shares): the fused capture
    (rgb) and the point-by-point one (polarized) equal the port's local
    exhaustive capture, the transient bit for bit."""
    d = nlos_scene(sx=2, sy=2)
    d["integrator"]["capture_type"] = "exhaustive"
    d["relay_wall"]["nlos_sensor"]["film"].update(
        exhaustive_scan=True, laser_scan_width=3, laser_scan_height=2)
    with with_variant(mt, variant):
        s_loc, t_loc = mt.render(mt.load_dict(copy.deepcopy(d), device="cpu"),
                                 spp=16, seed=0)
        s_sh, t_sh, stats = tmesh.render_sharded(
            mt.load_dict(copy.deepcopy(d), device="cpu"), _shards(4),
            spp=16, seed=0, return_stats=True)
    C = 4 if variant == "mono_polarized" else 3
    assert stats["devices"] == 4
    assert tuple(t_sh.shape) == (2, 2, 2, 3, 300, C)
    np.testing.assert_array_equal(t_sh.numpy(), t_loc.numpy())
    np.testing.assert_allclose(s_sh.numpy(), s_loc.numpy(), rtol=1e-5,
                               atol=1e-7)
    assert float(t_sh.sum()) > 0


def test_refusals():
    cropped = mt.load_dict(_cbox(mt, 8, 8, 30, crop_width=4, crop_height=4),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="cropped"):
        tmesh.render_backward_sharded(cropped, _shards(2), (None, None),
                                      spp=2)
    d = nlos_scene(sx=2, sy=2)
    d["integrator"]["capture_type"] = "exhaustive"
    d["relay_wall"]["nlos_sensor"]["film"].update(
        exhaustive_scan=True, laser_scan_width=2, laser_scan_height=2)
    with pytest.raises(ValueError, match="Exhaustive"):
        tmesh.render_backward_sharded(mt.load_dict(d, device="cpu"),
                                      _shards(2), (None, None), spp=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()


def test_dryrun_matches_jax(capsys):
    """``dryrun_multichip`` on 8 CPU shards against the JAX package's
    sharded calls of the same configurations (``__graft_entry__``'s dry
    run), run here."""
    import jax.numpy as jnp

    import __graft_entry__ as ge

    got = dryrun_multichip(8, devices=["cpu"] * 8)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK: 8 devices")

    mesh = jmesh.make_mesh(8)
    scene = ge._small_cbox(w=8, h=8, bins=16, max_depth=3)
    s, t, stats = jmesh.render_sharded(scene, mesh, spp=16, seed=0,
                                       return_stats=True)
    g = jmesh.render_backward_sharded(
        scene, mesh, (None, np.ones((8, 8, 16, 3), np.float32)), spp=16,
        seed=0)["__tables__"]
    nscene = mitr.load_dict(ge._nlos_confocal_dict())
    mitr.nlos.focus_emitter_at_relay_wall_pixel([1.0, 1.0], nscene)
    _ns, nt = jmesh.render_sharded(nscene, mesh, spp=16, seed=0)
    ng = jmesh.render_backward_sharded(
        nscene, mesh, (None, np.ones(np.shape(nt), np.float32)), spp=8,
        seed=0)["__tables__"]
    want = {"steady": s, "transient": t, "nlos_transient": nt}
    for k, w in want.items():
        m = golden_mismatch(got[k], np.asarray(w))
        assert m["shape_ok"] and m["n_bad"] == 0, (k, m)
    for k, w in (("grad_bsdf_reflectance", g.bsdf_reflectance),
                 ("grad_emitter_radiance", g.emitter_radiance),
                 ("nlos_grad_bsdf_reflectance", ng.bsdf_reflectance)):
        w = np.asarray(w)
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=GRAD_ATOL * np.abs(w).max(),
                                   err_msg=k)
    assert abs(got["rays"] - float(stats["rays"])) <= RAYS_RTOL * float(
        stats["rays"])
    for k, w in (("steady_sum", jnp.sum(s)),
                 ("grad_norm", jnp.sum(jnp.abs(g.bsdf_reflectance))),
                 ("nlos_transient_sum", jnp.sum(nt))):
        np.testing.assert_allclose(got[k], float(w), rtol=5e-4, err_msg=k)
    assert got["exhaustive_transient"].shape == (2, 2, 2, 2, 32, 3)
