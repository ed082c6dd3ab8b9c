"""The port's phasor film against the JAX package on the CPU: the tracked
frequencies, one splat, the ``phasor`` golden (mono, spp 8, so the regen
loop) and a multi-pass render, and the refusals of both packages (rgb,
crops).

Tolerance: frequencies exactly (the same numpy code); the splat rtol 1e-5
(cos and sin of phases of a few hundred radians, whose ulps differ between
XLA and PyTorch); renders test_golden's rule, rtol 5e-4 and atol 5e-5 *
max, with no element out.
"""
import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu.film import phasor_film as jpf
from mitransient_tpu.scene.schema import FilmConfig as JFilmConfig
from mitransient_tpu_torch.film import phasor_film as tpf
from mitransient_tpu_torch.scene.schema import FilmConfig
from torch_cases import golden_mismatch

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "phasor.npz")
PHASOR_FILM = {"type": "phasor_hdr_film", "width": 8, "height": 8,
               "temporal_bins": 400, "bin_width_opl": 0.02, "start_opl": 3.5,
               "wl_mean": 0.5, "wl_sigma": 0.5}


def _desc():
    """The phasor golden's scene (tests/golden_configs.py:phasor)."""
    d = mt.cornell_box()
    d["integrator"]["max_depth"] = 4
    d["sensor"]["film"] = dict(PHASOR_FILM)
    return d


@pytest.fixture()
def mono():
    old = mitr.variant().name
    mitr.set_variant("mono")
    mt.set_variant("mono")
    yield
    mitr.set_variant(old)
    mt.set_variant("rgb")


def _assert_matches(got, want):
    for g, w in zip(got, want):
        m = golden_mismatch(np.asarray(g), np.asarray(w))
        assert m["shape_ok"] and m["n_bad"] == 0, m


@pytest.mark.parametrize("kw", [
    dict(temporal_bins=400, bin_width_opl=0.02, wl_mean=0.5, wl_sigma=0.5),
    dict(temporal_bins=4000, bin_width_opl=0.003, wl_mean=100.0,
         wl_sigma=100.0),
    dict(temporal_bins=4096),
    dict(temporal_bins=301, bin_width_opl=0.05, wl_mean=0.3, wl_sigma=2.0),
])
def test_frequencies_match_jax(kw):
    cfg = dict(kind="phasor_hdr_film", **kw)
    got = tpf.phasor_frequencies(FilmConfig(**cfg))
    want = jpf.phasor_frequencies(JFilmConfig(**cfg))
    assert got.dtype == np.float32 and len(got) >= 1
    np.testing.assert_array_equal(got, want)


def test_splat_matches_jax():
    cfg = dict(kind="phasor_hdr_film", width=6, height=5, **{
        k: PHASOR_FILM[k] for k in ("temporal_bins", "bin_width_opl",
                                     "start_opl", "wl_mean", "wl_sigma")})
    jcfg, tcfg = JFilmConfig(**cfg), FilmConfig(**cfg)
    rng = np.random.default_rng(0)
    spp, n = 3, 3 * 30
    dist = rng.uniform(3.0, 9.0, (2, n)).astype(np.float32)
    dist[0, :3] = [np.inf, np.nan, 3.5]
    vals = rng.random((2, n, 1)).astype(np.float32)
    active = rng.random(n) > 0.2
    args = (dist[0], vals[0], dist[1], vals[1], active)
    jst = jpf.splat_phasor_pair(jpf.phasor_film_init(jcfg, 1), jcfg, spp,
                                *map(jnp.asarray, args))
    tst = tpf.splat_phasor_pair(tpf.phasor_film_init(tcfg, 1), tcfg, spp,
                                *map(torch.from_numpy, args))
    want = np.asarray(jst.phasor)
    np.testing.assert_allclose(tst.phasor.numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    (js, jp), (ts, tp) = (jpf.develop_phasor(jst, jcfg),
                          tpf.develop_phasor(tst, tcfg))
    assert tp.shape == jp.shape == (5, 6, want.shape[0], 2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


def test_phasor_golden(mono):
    """The golden's render (mono, spp 8) goes through the regen loop."""
    s, p, stats = mt.render(mt.load_dict(_desc(), device="cpu"), spp=8,
                            seed=0, return_stats=True)
    assert "iters" in stats
    golden = np.load(GOLDEN)
    _assert_matches((s.numpy(), p.numpy()), (golden["steady"],
                                             golden["transient"]))


def test_multipass_phasor_matches_jax(mono):
    js, jp = mitr.render(mitr.load_dict(_desc()), spp=3, seed=1)
    ts, tp, stats = mt.render(mt.load_dict(_desc(), device="cpu"), spp=3,
                              seed=1, return_stats=True)
    assert "iters" not in stats
    _assert_matches((ts.numpy(), tp.numpy()), (js, jp))


def test_rgb_is_refused_as_jax_refuses_it():
    """Both packages refuse a phasor render in rgb when they make its
    film, with the same message."""
    msgs = []
    for pkg, kw in ((mitr, {}), (mt, {"device": "cpu"})):
        scene = pkg.load_dict(copy.deepcopy(_desc()), **kw)
        with pytest.raises(ValueError, match="monochromatic") as err:
            pkg.render(scene, spp=8, seed=0)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_crop_is_refused_as_jax_refuses_it():
    desc = _desc()
    desc["sensor"]["film"].update(crop_width=4, crop_offset_x=2)
    msgs = []
    for pkg, kw in ((mitr, {}), (mt, {"device": "cpu"})):
        with pytest.raises(ValueError, match="cropped") as err:
            pkg.load_dict(copy.deepcopy(desc), **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
