"""The port's volumetric differentiation against the JAX package on the
CPU: the PRB replay (``render_backward`` of ``transient_prbvolpath``, one
chunk and several), full AD (``method="fullad"``), forward mode
(``render_forward``), the heterogeneous replay of
tests/test_prb_vol.py:93, and ``traverse`` of the media's parameters.

Both packages replay the same threefry streams.  Tolerances: gradient
tables within 1e-4 of each table's largest |value| (float32 sums over
the lanes in another order, and XLA:CPU's FMA contraction); derivative
videos the same, of each video's largest |value|; renders after a
``traverse`` update under test_golden's rule.

The configurations are ``torch_cases.vol_grad_case``'s (test_prb_vol.py's
fog box and its heterogeneous case, the small box 2 mm off the floor),
under seeded random adjoints and seed 3.  At seeds 0-2 one
lane in 256 parts between the packages: its shadow ray leaves a face of
the large box at a grazing angle, and with XLA's FMA-contracted hit point
it re-hits its own triangle within the walk's 1e-4 offset while the
port's separately rounded point does not (ROADMAP queue 3); such a lane
moves the geometry gradients of full AD by 1-2 %.
:func:`test_gradient_configs_have_no_parted_lane` holds the seed used here
to none.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu.render import render_backward_volpath as j_volpath_bwd
from mitransient_tpu.core import rng as jrng
from mitransient_tpu.film import transient_film as jf
from mitransient_tpu.integrators import volpath as jvol
from mitransient_tpu.sensors import perspective as jpersp
from mitransient_tpu_torch.convert import diff_params_to_numpy
from mitransient_tpu_torch.core import rng as trng
from mitransient_tpu_torch.film import transient_film as tf
from mitransient_tpu_torch.integrators import volpath as tvol
from mitransient_tpu_torch.render import render_backward_volpath
from mitransient_tpu_torch.sensors import perspective as tpersp
from torch_cases import (
    VOL_LIFT,
    golden_mismatch,
    hetero_medium,
    vol_cbox,
    vol_grad_case,
)

torch.set_num_threads(1)

SEED, SPP = 3, 4
TABLES = ("bsdf_reflectance", "emitter_radiance", "medium_albedo",
          "medium_sigma_t", "shape_translate", "shape_rotate")


def _adjoint(scene, seed=0):
    fc = scene.sensors[0].film
    rng = np.random.default_rng(seed)
    return (rng.random((fc.height, fc.width, 3)).astype(np.float32),
            rng.random((fc.height, fc.width, fc.temporal_bins, 3)).astype(
                np.float32))


@pytest.fixture(scope="module")
def scenes():
    cache = {}

    def get(name):
        if name not in cache:
            d = vol_grad_case(mitr, name)
            cache[name] = (mitr.load_dict(copy.deepcopy(d)),
                           mt.load_dict(copy.deepcopy(d), device="cpu"))
        return cache[name]

    return get


def _close_tables(got, want, fields):
    got = diff_params_to_numpy(got)
    for f in fields:
        g, w = got[f], getattr(want, f)
        assert (g is None) == (w is None), f
        if g is None:
            continue
        w = np.asarray(w, np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                   err_msg=f)


@pytest.mark.parametrize("name", ["fog", "grid"])
def test_prb_backward_matches_jax(scenes, name):
    """The replay's tables (a steady and a transient adjoint, one chunk);
    the medium's albedo and, in homogeneous fog, sigma_t get gradients."""
    jsc, tsc = scenes(name)
    adj = _adjoint(tsc)
    jg = mitr.render_backward(jsc, adj, spp=SPP, seed=SEED)
    tg = mt.render_backward(tsc, adj, spp=SPP, seed=SEED)
    _close_tables(tg["__tables__"], jg["__tables__"], TABLES[:4])
    assert float(tg["__tables__"].medium_albedo.abs().max()) > 0
    sig = float(tg["__tables__"].medium_sigma_t.abs().max())
    assert (sig > 0) == (name == "fog")  # grid tracking stays detached
    key = next(k for k in tsc._param_paths if k.endswith("albedo.value"))
    np.testing.assert_allclose(tg[key].numpy(), np.asarray(jg[key]),
                               rtol=0, atol=1e-4 * float(np.abs(
                                   np.asarray(jg[key])).max()))


def test_prb_backward_in_chunks_matches_jax(scenes):
    """render_backward_volpath over 3 chunks (spp 6 at 2 a chunk): the
    pass index seeds each chunk, so the split must be the JAX package's."""
    jsc, tsc = scenes("fog")
    adj = (None, _adjoint(tsc, 1)[1])
    jg = j_volpath_bwd(jsc, adj, spp=6, seed=SEED, max_lanes=2 * 64)
    tg = render_backward_volpath(tsc, adj, spp=6, seed=SEED,
                                 max_lanes=2 * 64)
    _close_tables(tg["__tables__"], jg["__tables__"], TABLES[:4])
    one = render_backward_volpath(tsc, adj, spp=6, seed=SEED)
    assert not torch.allclose(one["__tables__"].bsdf_reflectance,
                              tg["__tables__"].bsdf_reflectance)


@pytest.mark.parametrize("name", ["fog", "grid"])
def test_fullad_matches_jax(scenes, name):
    """Full AD through the volumetric wavefront: the tables and the
    geometry gradients (shape poses)."""
    jsc, tsc = scenes(name)
    adj = (None, _adjoint(tsc, 2)[1])
    jg = mitr.render_backward(jsc, adj, spp=SPP, seed=SEED, method="fullad")
    tg = mt.render_backward(tsc, adj, spp=SPP, seed=SEED, method="fullad")
    _close_tables(tg["__tables__"], jg["__tables__"], TABLES)
    assert float(tg["__tables__"].shape_translate.abs().max()) > 0


@pytest.mark.parametrize("name", ["fog", "grid"])
def test_forward_matches_jax(scenes, name):
    """Forward mode along the albedo, the white reflectance and sigma_t at
    once: both derivative videos."""
    jsc, tsc = scenes(name)
    keys = list(tsc._param_paths)
    tangent = {next(k for k in keys if k.endswith("albedo.value")):
               np.ones(3, np.float32),
               next(k for k in keys if k.endswith("sigma_t.value")):
               np.float32(0.7),
               "white.reflectance.value": np.full(3, 0.5, np.float32)}
    want = mitr.render_forward(jsc, tangent, spp=SPP, seed=SEED)
    got = mt.render_forward(tsc, tangent, spp=SPP, seed=SEED)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()))
        assert float(np.abs(w).max()) > 0


def test_heterogeneous_replay_case_matches_jax():
    """tests/test_prb_vol.py:93's case (spp 32, seed 0, adjoint ones), its
    small box lifted 2 mm: the replay's albedo gradient.  (On the floor,
    as the JAX test has it, paths that leave the grid through the box's
    coplanar bottom part between the packages and move this gradient by
    1.5 %.)"""
    density = np.full((4, 4, 4), 0.8, np.float32)
    density[1:3, 1:3, 1:3] = 2.0
    d = vol_cbox(mitr, 1.0, lift=VOL_LIFT)
    d["small-box"]["medium"] = hetero_medium(density, scale=2.5, albedo=0.7)
    d["sensor"]["film"].update(start_opl=0.0, bin_width_opl=0.6)
    jsc, tsc = (mitr.load_dict(copy.deepcopy(d)),
                mt.load_dict(copy.deepcopy(d), device="cpu"))
    ones = np.ones((8, 8, 100, 3), np.float32)
    key = next(k for k in tsc._param_paths if k.endswith("albedo.value"))
    jg = mitr.render_backward(jsc, (None, ones), spp=32, seed=0)
    tg = mt.render_backward(tsc, (None, ones), spp=32, seed=0)
    w = np.asarray(jg[key])
    np.testing.assert_allclose(tg[key].numpy(), w, rtol=0,
                               atol=1e-4 * float(np.abs(w).max()))
    assert float(np.abs(w).max()) > 0


@pytest.mark.parametrize("name", ["fog", "grid"])
def test_gradient_configs_have_no_parted_lane(scenes, name):
    """At the seed the gradient tests use, every lane's primal radiance is
    the JAX package's (no lane takes another path), so that the gradients
    can be held to 1e-4."""
    jsc, tsc = scenes(name)
    n = 64 * SPP
    jsamp = jrng.Sampler(jnp.uint32(SEED), n, stream=jnp.uint32(0))
    jray, jpix, jw = jpersp.sample_rays(jpersp.build_camera(jsc.sensors[0]),
                                        jsamp, 8, 8, SPP)
    _f, jL, _v, _r = jvol.sample_volpath_primal(
        jsc.data, jsamp, jray, jpix, jw, jf.film_init(jsc.sensors[0].film, 3),
        jsc.sensors[0].film, jsc.integrator,
        sample_scale=jnp.float32(1 / SPP), base_dim=2, spp=SPP)
    tsamp = trng.Sampler(SEED, n, 0)
    cfg = tsc.sensors[0].film
    tray, tpix, tw = tpersp.sample_rays(tpersp.build_camera(tsc.sensors[0]),
                                        tsamp, 8, 8, SPP)
    _f, tL, _v, _r = tvol.sample_volpath_primal(
        tsc.data, tsamp, tray, tpix, tw, tf.film_init(cfg, 3), cfg,
        tsc.integrator, 1 / SPP, SPP)
    jL, tL = np.asarray(jL), tL.numpy()
    assert np.array_equal(jL == 0, tL == 0)
    np.testing.assert_allclose(tL, jL, rtol=1e-4, atol=1e-7)


def test_traverse_moves_media(scenes):
    """``traverse`` names each medium's albedo and sigma_t, reads them and
    updates them; the updated scene renders as the JAX package's does
    after the same update, and differently from before."""
    d = vol_grad_case(mitr, "fog")
    jsc, tsc = (mitr.load_dict(copy.deepcopy(d)),
                mt.load_dict(copy.deepcopy(d), device="cpu"))
    jp, tp = mitr.traverse(jsc), mt.traverse(tsc)
    keys = [k for k in tp.keys() if ".medium." in k]
    assert sorted(keys) == sorted(k for k in jp.keys() if ".medium." in k)
    assert sorted(keys) == ["small-box.medium.albedo.value",
                            "small-box.medium.sigma_t.value"]
    np.testing.assert_allclose(tp["small-box.medium.albedo.value"].numpy(),
                               [0.8, 0.8, 0.8], rtol=1e-6)
    before = mt.render(tsc, spp=2, seed=SEED)[1]
    for p in (jp, tp):
        p["small-box.medium.albedo.value"] = np.array([0.3, 0.5, 0.9],
                                                      np.float32)
        p["small-box.medium.sigma_t.value"] = np.float32(3.5)
        p.update()
    assert float(tp["small-box.medium.sigma_t.value"]) == 3.5
    assert tsc._media[0]["sigma_t"] == 3.5
    for got, want in zip(mt.render(tsc, spp=2, seed=SEED),
                         mitr.render(jsc, spp=2, seed=SEED)):
        m = golden_mismatch(got.numpy(), np.asarray(want))
        assert m["n_bad"] == 0, m
    assert not torch.equal(before, mt.render(tsc, spp=2, seed=SEED)[1])
