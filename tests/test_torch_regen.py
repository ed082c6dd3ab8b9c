"""The port's slice as a whole: the regen render of the Cornell box on the
CPU against the JAX package's golden and its renders, plus the physics
and determinism checks of tests/test_regen.py run on the port.

Tolerance against goldens and JAX renders: test_golden's, rtol 5e-4 and
atol 5e-5 * max.  The port draws the same samples as the JAX package (the
PCG hash is bit-exact and sample ids do not depend on the lane budget), so
the images agree per sample, not only statistically.

The loop's seed on the device (``path_regen.stream_keys``) and its blocks
run on the buffers of a ``regengraph.RegenGraph``, eagerly as on the CPU
and before a capture on the card, are held to the plain loop bit for bit.
"""
import os

import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu_torch import passgraph, regengraph
from mitransient_tpu_torch.film import transient_film as tf
from mitransient_tpu_torch.integrators import path_regen
from mitransient_tpu_torch.integrators.nlos_path import film_channels
from mitransient_tpu_torch.ops.bvh import BVH_MODE
from mitransient_tpu_torch.scene.scene import primal_sd
from mitransient_tpu_torch.sensors.perspective import build_camera
from torch_cases import (
    golden_mismatch,
    physics_checks,
    polarized_cbox,
    small_cbox,
    with_variant,
)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "cbox_rgb.npz")


def _render(desc, **kw):
    s, t = mt.render(mt.load_dict(desc, device="cpu"), **kw)
    return s.numpy(), t.numpy()


def _assert_matches(got: dict, want: dict):
    for k in ("steady", "transient"):
        m = golden_mismatch(got[k], want[k])
        assert m["shape_ok"] and m["n_bad"] == 0, (k, m)


def test_cbox_rgb_matches_golden():
    s, t = _render(small_cbox(mt), spp=8, seed=0)
    golden = np.load(GOLDEN)
    _assert_matches({"steady": s, "transient": t}, golden)


def test_matches_jax_render_and_ray_count():
    """Same config rendered by both packages now (not the stored golden):
    images within the golden tolerance, the same iteration count, and ray
    counts (bench.py's: closest-hit lanes plus NEE shadow rays) within
    0.1%.  The counts are discrete: where XLA's FMA contraction and the
    port's separate rounding part at a grazing NEE or shadow test, one ray
    more or less is traced (9091 against 9090 here)."""
    desc = small_cbox(mitr, 12, 12, 60, 5)
    js, jt, jstats = mitr.render(mitr.load_dict(desc), spp=12, seed=3,
                                 return_stats=True)
    ts, tt, tstats = mt.render(mt.load_dict(desc, device="cpu"), spp=12, seed=3,
                               return_stats=True)
    _assert_matches({"steady": ts.numpy(), "transient": tt.numpy()},
                    {"steady": np.asarray(js), "transient": np.asarray(jt)})
    rays, jrays = int(tstats["rays"]), int(np.asarray(jstats["rays"]))
    assert abs(rays - jrays) <= 1e-3 * jrays and rays > 5000
    assert int(tstats["iters"]) == int(np.asarray(jstats["iters"]))
    assert tstats["loop_iters"] >= int(tstats["iters"])


def test_mono_matches_jax():
    """The JAX package squeezes mono state to (N,); the port carries
    (N, 1).  Same estimator, same samples."""
    desc = small_cbox(mitr, 8, 8, 80, 4)
    old = mitr.variant()
    mitr.set_variant("mono")
    mt.set_variant("mono")
    try:
        js, jt = mitr.render(mitr.load_dict(desc), spp=8, seed=1)
        ts, tt = _render(desc, spp=8, seed=1)
    finally:
        mitr.set_variant(old)
        mt.set_variant("rgb")
    assert ts.shape == (8, 8, 1)
    _assert_matches({"steady": ts, "transient": tt},
                    {"steady": np.asarray(js), "transient": np.asarray(jt)})


def test_regen_energy_and_physics():
    """tests/test_regen.py::test_regen_energy_and_physics on the port."""
    s, t = _render(small_cbox(mt, 24, 24, 300, 8), spp=64, seed=0)
    assert physics_checks(s, t, red_green=False) == []


def test_regen_deterministic():
    desc = small_cbox(mt, 12, 12, 60, 8)
    s1, t1 = _render(desc, spp=16, seed=5)
    s2, t2 = _render(desc, spp=16, seed=5)
    assert np.array_equal(s1, s2) and np.array_equal(t1, t2)


def test_regen_full_budget_per_pixel():
    """Doubling spp must not change the mean (it is an average)."""
    desc = small_cbox(mt, 12, 12, 60, 8)
    m1 = _render(desc, spp=32, seed=0)[0].mean()
    m2 = _render(desc, spp=64, seed=0)[0].mean()
    assert abs(m1 - m2) / max(m2, 1e-9) < 0.1


def test_samples_do_not_depend_on_the_lane_budget():
    """Sample ids are sample_idx * HW + pixel at any lanes per pixel, so 2
    lanes per pixel render the very samples of 16; only the order of the
    float additions changes (rtol 1e-5)."""
    desc = small_cbox(mt, 8, 8, 60, 6)
    s16, t16 = _render(desc, spp=16, seed=2)
    s2, t2 = _render(desc, spp=16, seed=2, max_lanes=2 * 64)
    np.testing.assert_allclose(s2, s16, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t2, t16, rtol=1e-5, atol=1e-7)


def test_output_does_not_depend_on_the_live_check_period(monkeypatch):
    """Iterations after the last lane died add exact zeros."""
    desc = small_cbox(mt, 8, 8, 60, 6)
    s8, t8 = _render(desc, spp=8, seed=4)
    monkeypatch.setattr(path_regen, "LIVE_CHECK_EVERY", 1)
    s1, t1 = _render(desc, spp=8, seed=4)
    assert np.array_equal(s1, s8) and np.array_equal(t1, t8)


def test_renders_take_the_branch_the_jax_package_takes():
    """Below 8 spp, with regenerate=False and on resume the render goes
    through the multi-pass accumulator (no ``iters`` in its stats, one
    pass of max_depth bounces here), at 8 spp and more through the regen
    loop; tests/test_torch_path.py holds the multi-pass renders to JAX."""
    scene = mt.load_dict(small_cbox(mt, 8, 8, 60, 4), device="cpu")
    states = []
    for kw in (dict(spp=4, checkpoint_callback=states.append),
               dict(spp=8, regenerate=False)):
        _s, _t, stats = mt.render(scene, return_stats=True, **kw)
        assert "iters" not in stats and stats["loop_iters"] == 4, kw
    _s, _t, stats = mt.render(scene, spp=4, film_state=states[0],
                              return_stats=True)
    assert "iters" not in stats and stats["loop_iters"] == 0
    _s, _t, stats = mt.render(scene, spp=8, return_stats=True)
    assert "iters" in stats


def test_unknown_bvh_mode_is_refused():
    scene = mt.load_dict(small_cbox(mt), device="cpu")
    with pytest.raises(ValueError, match="bvh_mode"):
        mt.render(scene, spp=8, bvh_mode="tree")


SEEDS = [0, 7, 2**31 + 3, 2**32 + 5, 2**40 + 11]


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_uniform_takes_the_seed_as_a_device_scalar(seed):
    """A 0-dim int64 tensor seed draws the Python int's bits (both masked
    to 32 bits; 2^32 + 5 is 5) at the camera's dimensions 0 and 1 and at a
    bounce's, and the loop's stream keys (the seed's hash and the jitter
    keys, made on the device once a render) draw them too."""
    sid = torch.arange(0, 1 << 20, 4099, dtype=torch.int64)
    depth = torch.arange(sid.shape[0], dtype=torch.int64) % 8
    seed_t = torch.tensor(seed, dtype=torch.int64)
    keys = path_regen.stream_keys(seed, "cpu")
    assert keys.dtype == torch.int64 and keys.shape == (3,)
    for dim in (0, 1, 2 + depth * path_regen.DIMS_PER_BOUNCE + 3):
        want = path_regen.hash_uniform(seed, sid, dim)
        got = path_regen.hash_uniform(seed_t, sid, dim)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        key = (keys[1 + dim] if isinstance(dim, int)
               else path_regen._pcg((dim & path_regen._M32) ^ keys[0]))
        drawn = path_regen._hash_draw(key, sid)
        assert torch.equal(drawn.view(torch.int32), want.view(torch.int32))


def _regen_case(name):
    """(scene, spp, max_lanes) of a block-machinery case on the CPU."""
    if name == "mono_polarized":
        with with_variant(mt, name):
            return (mt.load_dict(polarized_cbox(mt, 8, 40, 4), device="cpu"),
                    12, 3 * 64)
    if name == "mono":
        with with_variant(mt, name):
            return (mt.load_dict(small_cbox(mt, 8, 8, 40, 4), device="cpu"),
                    12, 3 * 64)
    if name == "tail":  # 15 iterations: a block of 8, then 7 eagerly
        return mt.load_dict(small_cbox(mt, 8, 8, 60, 2), device="cpu"), 12, 128
    return mt.load_dict(small_cbox(mt, 8, 8, 40, 4), device="cpu"), 12, 3 * 64


def _regen(scene, spp, seed, max_lanes, graph=None):
    """``sample_primal_regen`` on the scene's CPU tensors -> (transient,
    steady lanes, n_rays, iters, loop_iters)."""
    cfg, icfg, var = scene.sensors[0], scene.integrator, scene.variant
    fc = cfg.film
    lanes = max(1, min(spp, max_lanes // (fc.width * fc.height)))
    film = tf.film_init_any(fc, film_channels(var), device="cpu")
    out = path_regen.sample_primal_regen(
        primal_sd(scene.data), seed, build_camera(cfg, device="cpu"), film,
        fc, icfg, spp, lanes, BVH_MODE, polarized=var.polarized, graph=graph)
    assert out[0].transient is film.transient
    return out[0].transient, *out[1:]


@pytest.mark.parametrize("name, period", [
    ("mono", 8), ("rgb", 8), ("mono_polarized", 8), ("mono", 1), ("rgb", 1),
    ("mono_polarized", 1), ("tail", 8)])
def test_block_machinery_is_the_plain_loop_bit_for_bit(monkeypatch, name,
                                                       period):
    """Two seeds through one ``RegenGraph`` on the CPU, its blocks run
    eagerly on its own buffers (copies of the scene and camera, the stream
    keys, the carry), as the card's first block runs: the films, steady
    sums, ``n_rays``, ``iters`` and ``loop_iters`` of the plain loop, and a
    block counted for each live check that found a lane.  "tail" runs to
    ``max_iters``, whose last 7 iterations are shorter than a block."""
    monkeypatch.setattr(path_regen, "LIVE_CHECK_EVERY", period)
    scene, spp, max_lanes = _regen_case(name)
    cfg, icfg, var = scene.sensors[0], scene.integrator, scene.variant
    fc = cfg.film
    lanes = max(1, min(spp, max_lanes // (fc.width * fc.height)))
    g = regengraph.RegenGraph(
        None, primal_sd(scene.data), build_camera(cfg, device="cpu"),
        tf.film_init_any(fc, film_channels(var)), torch.device("cpu"),
        film_cfg=fc, icfg=icfg, spp_total=spp, lanes_per_pixel=lanes,
        bvh_mode=BVH_MODE, polarized=var.polarized)
    for seed in (2, 2**32 + 3):
        before = dict(passgraph.STATS)
        got = _regen(scene, spp, seed, max_lanes, graph=g)
        counted = {k: passgraph.STATS[k] - before[k] for k in before}
        want = _regen(scene, spp, seed, max_lanes)
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert int(got[2]) == int(want[2]) and int(got[3]) == int(want[3])
        assert got[4] == want[4]
        assert counted == {"captures": 0, "replays": 0, "eager_passes": 0,
                           "refusals": 0,
                           "eager_blocks": -(-got[4] // period)}
        assert g.graph is None and g.film is None
    if name == "tail":
        assert got[4] == 15  # 8 + 7


def test_regen_graph_route_is_taken_on_a_cuda_device_into_a_transient_film():
    """The predicate reads the device and the film's kind only; a CPU
    render keeps no graph."""
    cbox = mt.load_dict(mt.cornell_box(), device="cpu")
    film = cbox.sensors[0].film
    assert regengraph.eligible(torch.device("cuda", 0), film)
    assert regengraph.eligible("cuda", film)
    assert not regengraph.eligible("cpu", film)
    assert not regengraph.eligible(
        "cuda", film._replace(kind="phasor_hdr_film"))
    _render(small_cbox(mt, 8, 8, 40, 4), spp=8, seed=0)
    assert passgraph._GRAPHS == {}
