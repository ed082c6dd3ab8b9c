"""The multi-pass perspective render of the port against the JAX package on
the CPU: ``sample_rays``, one pass of ``sample_primal``, and ``render``
through the multi-pass accumulator in each configuration that takes it
(spp below 8, ``regenerate=False``, several passes, ``camera_unwarp``, the
gaussian temporal filter and rfilter, a crop window,
``discard_direct_light``, the ``path`` integrator, and a scene with an
accel), plus the ``cbox_rgb_multipass`` golden and checkpoint/resume.

Both packages draw the same threefry streams (tests/test_torch_rng.py), so
the renders agree per sample.  Tolerance: test_golden's, rtol 5e-4 and atol
5e-5 * max, with no element out; ray counts within 0.1 % (XLA:CPU contracts
FMAs and the port does not, which can flip a rare grazing decision; the
JAX count is float32).  Camera rays agree to rtol 1e-6.
"""
import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu.core import rng as jrng
from mitransient_tpu.film import transient_film as jf
from mitransient_tpu.integrators import path as jpath
from mitransient_tpu.scene.scene import primal_sd as j_primal_sd
from mitransient_tpu.sensors import perspective as jpersp
from mitransient_tpu_torch.core import rng as trng
from mitransient_tpu_torch.film import transient_film as tf
from mitransient_tpu_torch.integrators import path as tpath
from mitransient_tpu_torch.scene.scene import primal_sd
from mitransient_tpu_torch.sensors import perspective as tpersp
from torch_cases import golden_mismatch, small_cbox, small_sphere_cbox

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "cbox_rgb_multipass.npz")


def _desc():
    """8x8 box, 100 bins of 0.02 from OPL 3.5 (first arrival near bin 17),
    max_depth 4."""
    return small_cbox(mitr, 8, 8, 100, 4)


def _case(name):
    d = _desc()
    kw = dict(spp=4)
    if name == "spp4":
        pass
    elif name == "regenerate_false":
        kw = dict(spp=8, regenerate=False)
    elif name == "passes":  # 3 passes of 4 spp at 3 lanes a pixel
        kw = dict(spp=10, max_lanes=3 * 64, regenerate=False)
    elif name == "camera_unwarp":
        d["integrator"]["camera_unwarp"] = True
    elif name == "gaussian_temporal":
        d["integrator"].update(temporal_filter="gaussian", gaussian_stddev=1.5)
    elif name == "gaussian_rfilter":
        d["sensor"]["film"]["rfilter"] = {"type": "gaussian", "stddev": 0.6}
    elif name == "crop":
        d["sensor"]["film"].update(crop_offset_x=2, crop_offset_y=1,
                                   crop_width=5, crop_height=4)
    elif name == "discard_direct_light":
        d["integrator"]["discard_direct_light"] = True
    elif name == "path_integrator":  # spp 8: "path" never takes regen
        d["integrator"]["type"] = "path"
        kw = dict(spp=8)
    elif name == "accel":
        d, kw = small_sphere_cbox(mitr), dict(spp=2)
    return d, dict(kw, seed=3)


CASES = ["spp4", "regenerate_false", "passes", "camera_unwarp",
         "gaussian_temporal", "gaussian_rfilter", "crop",
         "discard_direct_light", "path_integrator", "accel"]


def _assert_matches(got, want):
    for g, w in zip(got, want):
        m = golden_mismatch(np.asarray(g), np.asarray(w))
        assert m["shape_ok"] and m["n_bad"] == 0, m


@pytest.fixture(scope="module")
def jax_renders():
    """The JAX package's render of each case, made once (each case is an
    XLA compile)."""
    cache = {}

    def get(name):
        if name not in cache:
            desc, kw = _case(name)
            s, t, stats = mitr.render(mitr.load_dict(desc), return_stats=True,
                                      **kw)
            cache[name] = (np.asarray(s), np.asarray(t),
                           float(np.asarray(stats["rays"])), stats["spp"])
        return cache[name]

    return get


@pytest.mark.parametrize("name", CASES)
def test_render_matches_jax(jax_renders, name):
    desc, kw = _case(name)
    js, jt, jrays, jspp = jax_renders(name)
    ts, tt, stats = mt.render(mt.load_dict(copy.deepcopy(desc), device="cpu"),
                              return_stats=True, **kw)
    assert "iters" not in stats  # the multi-pass branch, not regen
    assert stats["spp"] == jspp
    _assert_matches((ts.numpy(), tt.numpy()), (js, jt))
    rays = int(stats["rays"])
    assert abs(rays - jrays) <= 1e-3 * jrays and rays > 0
    assert float(np.abs(jt).sum()) > 0.0  # the case splats into the film


@pytest.mark.parametrize("crop", [False, True])
def test_sample_rays_matches_jax(crop):
    desc = _desc()
    if crop:
        desc["sensor"]["film"].update(crop_offset_x=3, crop_offset_y=2,
                                      crop_width=4, crop_height=5)
    fc = mitr.load_dict(desc).sensors[0].film
    jcam = jpersp.build_camera(mitr.load_dict(desc).sensors[0])
    tcam = tpersp.build_camera(mt.load_dict(desc, device="cpu").sensors[0])
    w, h, spp = fc.data_width, fc.data_height, 3
    kw = dict(crop_offset=(fc.crop_offset_x, fc.crop_offset_y),
              full_size=(fc.width, fc.height))
    jray, jpix, jw = jpersp.sample_rays(
        jcam, jrng.Sampler(jnp.uint32(7), w * h * spp, stream=jnp.uint32(2)),
        w, h, spp, **kw)
    tray, tpix, tw = tpersp.sample_rays(tcam, trng.Sampler(7, w * h * spp, 2),
                                        w, h, spp, **kw)
    np.testing.assert_array_equal(tpix.numpy(), np.asarray(jpix))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tray.o.numpy(), np.asarray(jray.o))
    np.testing.assert_allclose(tray.d.numpy(), np.asarray(jray.d), rtol=1e-6,
                               atol=1e-7)
    assert tray.o.is_contiguous() and tray.d.is_contiguous()


def test_sample_primal_one_pass_matches_jax():
    """One pass of 3 spp: the transient film (overflow bin included), the
    per-lane L and the ray count."""
    desc = _desc()
    jsc, tsc = mitr.load_dict(desc), mt.load_dict(desc, device="cpu")
    cfg, jcfg = tsc.sensors[0].film, jsc.sensors[0].film
    spp, n = 3, 3 * 64
    jsamp = jrng.Sampler(jnp.uint32(4), n, stream=jnp.uint32(1))
    jray, jpix, jw = jpersp.sample_rays(jpersp.build_camera(jsc.sensors[0]),
                                        jsamp, 8, 8, spp)
    jfilm, jL, jvalid, jrays = jpath.sample_primal(
        j_primal_sd(jsc.data), jsamp, jray, jpix, jw, jf.film_init(jcfg, 3),
        jcfg, jsc.integrator, sample_scale=jnp.float32(1 / 3), base_dim=2,
        spp=spp)
    tsamp = trng.Sampler(4, n, 1)
    tray, tpix, tw = tpersp.sample_rays(tpersp.build_camera(tsc.sensors[0]),
                                        tsamp, 8, 8, spp)
    tfilm, tL, tvalid, trays = tpath.sample_primal(
        primal_sd(tsc.data), tsamp, tray, tpix, tw, tf.film_init(cfg, 3),
        cfg, tsc.integrator, sample_scale=1 / 3, spp=spp)
    T = cfg.temporal_bins
    _assert_matches((tfilm.transient.numpy(), tL.numpy()),
                    (np.asarray(jfilm.transient)[:, :T + 1, :64],
                     np.asarray(jL)))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert trays.dtype == torch.int64
    jr = float(np.asarray(jrays))
    assert abs(int(trays) - jr) <= 1e-3 * jr and jr > 0


def test_cbox_rgb_multipass_matches_golden():
    s, t, stats = mt.render(mt.load_dict(small_cbox(mt), device="cpu"),
                            spp=8, seed=0, regenerate=False, return_stats=True)
    golden = np.load(GOLDEN)
    _assert_matches((s.numpy(), t.numpy()), (golden["steady"],
                                             golden["transient"]))
    assert stats["loop_iters"] == 6  # one pass of max_depth 6 bounces


def test_checkpoint_resume_is_bit_identical(tmp_path):
    """Resuming from any pass's checkpoint, in memory or through
    save_film_state / load_film_state, gives the uninterrupted render bit
    for bit; the checkpoint holds host copies that later passes leave
    alone."""
    scene = mt.load_dict(small_cbox(mt, 8, 8, 60, 4), device="cpu")
    kw = dict(spp=12, seed=2, max_lanes=3 * 64, regenerate=False)
    states, progress = [], []
    s0, t0, stats = mt.render(scene, checkpoint_callback=states.append,
                              progress_callback=progress.append,
                              return_stats=True, **kw)
    assert [st[1] for st in states] == [1, 2, 3, 4]
    assert progress == [0.25, 0.5, 0.75, 1.0]
    assert states[-1][2] == int(stats["rays"])
    assert all(isinstance(a, np.ndarray) for a in states[0][0])
    assert not np.array_equal(states[0][0].transient, states[1][0].transient)
    path = tmp_path / "film.npz"
    mt.save_film_state(str(path), states[1])
    loaded = mt.load_film_state(str(path))
    assert loaded[1:] == states[1][1:]
    for state in (loaded, states[2], states[3]):
        s1, t1, st1 = mt.render(scene, film_state=state, return_stats=True,
                                **kw)
        assert torch.equal(s1, s0) and torch.equal(t1, t0)
        assert int(st1["rays"]) == int(stats["rays"])
        assert st1["loop_iters"] == (4 - state[1]) * 4
    # the resumed render left the loaded state as it was
    np.testing.assert_array_equal(loaded[0].transient.numpy(),
                                  states[1][0].transient)


def test_film_state_of_another_variant_is_refused():
    scene = mt.load_dict(small_cbox(mt, 8, 8, 60, 4), device="cpu")
    states = []
    mt.render(scene, spp=2, seed=0, checkpoint_callback=states.append)
    mt.set_variant("mono")
    try:
        mono = mt.load_dict(small_cbox(mt, 8, 8, 60, 4), device="cpu")
        with pytest.raises(ValueError, match="film_state"):
            mt.render(mono, spp=2, seed=0, film_state=states[0])
    finally:
        mt.set_variant("rgb")
